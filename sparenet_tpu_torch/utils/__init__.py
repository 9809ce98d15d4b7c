"""Utilities of the port: weight conversion from the JAX package, serving
mode's mml calibration, the evaluation metrics, checkpoints (the port's
torch files and the JAX package's bf16 archive), logging and the result
table."""
