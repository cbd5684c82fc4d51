"""The plain reference: Gesture2Vec's generation path and Part-b step in
plain PyTorch, fp32, TF32 off. It imports nothing of the program; it
reads the weights the benchmark made, by the names of the port's
checkpoint layout, and works out again everything the program derives
from them."""
