"""The plain reference of the benchmark: the models and searches that the
port runs, written again in plain PyTorch (float32, TF32 off) and NumPy
from their published descriptions. It imports nothing of the port and
takes nothing the port has made: the benchmark hands it the same seeded
weights and inputs it hands the port, and it works out again whatever the
port derives from them. Each module states where its arithmetic departs
from the port's."""
