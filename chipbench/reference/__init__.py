"""The plain references the benchmark holds the program to: a dense GQA
decoder in float32 (`decoder`) that works out the tiered KV store again,
and its training step (`train`). Plain PyTorch only: nothing here
imports the program, JAX or the JAX package, and nothing reads what the
program made."""
