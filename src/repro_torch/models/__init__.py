"""Model definitions of the port: the dense GQA transformer (llama3.2-1b)."""
