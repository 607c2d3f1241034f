"""The benchmark's plain reference: frozen PyTorch copies of what the timed
path computes, written from the models' published descriptions.

Nothing here imports ``jax``, the JAX package or the port: the reference
is judged independent of the program it judges. It works out again
whatever the program derives from the benchmark's inputs (batch plans,
flips, dropout masks, aggregation weights, optimizer moments).
"""
