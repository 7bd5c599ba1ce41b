"""Model serving in the port: batched greedy decode for the LM archs,
batched scoring for MIND.

    PYTHONPATH=src python -m repro_torch.launch.model_serve --arch llama3.2-1b \
        --smoke --batch 4 --prompt-len 16 --gen 8            # on the GPU
    ... --arch qwen2-moe-a2.7b | minicpm3-4b | qwen2-72b | arctic-480b | mind
    ... --device cpu                                        # plain versions, CPU

The port of ``repro/launch/model_serve.py``'s ``lm_serve``: the prompt goes
through decode steps from position 0 (the reference's "prefill via decode
loop"), then ``gen`` tokens are chosen by greedy argmax, each step one
``decode_step`` against a cache of ``prompt_len + gen`` positions.  Like
the reference's CLI, ``main`` serves the smoke config (``--smoke`` is
accepted for the same command line); :func:`lm_serve` also takes a config,
so a caller can serve ``arch.full()``.  :func:`mind_serve` is the
reference's ``mind_serve``: ``batch`` users' random behaviour scored against
64 random candidates each; ``main`` dispatches on ``arch.family`` as the
reference does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as tf


def decode_loop(cfg: tf.TransformerConfig, params: dict, prompts: torch.Tensor, gen: int) -> torch.Tensor:
    """The reference's serving loop over ``prompts [B, P]``: returns the
    ``gen`` greedy tokens of each row, ``[B, gen]``."""
    batch, prompt_len = prompts.shape
    dev = prompts.device
    cache = tf.init_cache(cfg, batch, prompt_len + gen, device=dev)
    tok = prompts[:, 0]
    out = []
    for t in range(prompt_len + gen - 1):
        pos = torch.full((batch,), t, dtype=torch.long, device=dev)
        logits, cache = tf.decode_step(cfg, params, cache, tok, pos)
        if t + 1 < prompt_len:
            tok = prompts[:, t + 1]
        else:
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
    return torch.stack(out, dim=1) if out else prompts.new_empty((batch, 0))


def lm_serve(arch, batch: int, prompt_len: int, gen: int, *, cfg: tf.TransformerConfig | None = None,
             device=None) -> dict:
    """Serve ``batch`` random prompts (numpy seed 0, as the reference) with
    weights drawn from a ``torch.Generator`` seeded 0; ``cfg`` defaults to
    ``arch.smoke()``.  Prints the reference's line and returns the tokens
    (on the host), the seconds and tokens/s."""
    cfg = cfg if cfg is not None else arch.smoke()
    dev = resolve_device(device)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)

    t0 = time.perf_counter()
    tokens = decode_loop(cfg, params, prompts, gen).cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"served {batch} seqs × {gen} new tokens in {dt:.2f}s "
          f"({batch * gen / dt:.1f} tok/s, {cfg.name} on {dev})")
    return {"tokens": tokens, "seconds": dt, "tokens_per_s": batch * gen / dt}


def mind_serve(arch, batch: int, *, cfg=None, device=None) -> dict:
    """Score ``batch`` users (behaviour of ``cfg.seq_len`` items, all valid)
    against 64 candidates each, inputs from numpy seed 0 as the reference's,
    weights from a ``torch.Generator`` seeded 0; ``cfg`` defaults to
    ``arch.smoke()``.  Prints the reference's line and returns the scores
    (on the host) and the seconds."""
    from repro_torch.configs import mind as mind_cfg
    from repro_torch.models.recsys import mind as m

    cfg = cfg if cfg is not None else arch.smoke()
    dev = resolve_device(device)
    params = m.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    beh = torch.from_numpy(rng.integers(0, cfg.num_items, (batch, cfg.seq_len))).to(dev)
    valid = torch.ones((batch, cfg.seq_len), dtype=torch.bool, device=dev)
    cands = torch.from_numpy(rng.integers(0, cfg.num_items, (batch, 64))).to(dev)
    score = mind_cfg.make_serve(cfg)
    t0 = time.perf_counter()
    s = score(params, beh, valid, cands).cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"scored {batch}×64 candidates in {dt:.3f}s; top: "
          f"{torch.argmax(s, dim=-1)[:4].numpy()}")
    return {"scores": s, "seconds": dt}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if arch.family == "lm":
        lm_serve(arch, args.batch, args.prompt_len, args.gen, device=args.device)
    elif arch.family == "recsys":
        mind_serve(arch, args.batch, device=args.device)
    else:
        raise SystemExit(f"{arch.name} has no serving path")


if __name__ == "__main__":
    main()
