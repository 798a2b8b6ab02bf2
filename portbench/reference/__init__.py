"""The benchmark's frozen plain-PyTorch reference (f32, TF32 off).

Copies of the port's model code with every hand-written kernel replaced by
its plain math. Nothing here imports JAX, the JAX package or the port.
"""
