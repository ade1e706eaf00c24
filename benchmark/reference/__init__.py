"""The plain reference of a STaR training step: float32 PyTorch, written
from the model's equations, importing nothing of the program."""
