"""The plain references, one module per model family: the weights each
family has (``groups``) and its forward pass in float32 PyTorch.  They
import neither ``jax`` nor the program."""
