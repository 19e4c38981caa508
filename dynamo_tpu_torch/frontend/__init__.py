"""The frontend pieces a worker needs: the tokenizer its guided decoding
validates candidate text with (frontend/tokenizer.py).  The HTTP
frontend itself is the JAX package's, which serves torch workers."""
