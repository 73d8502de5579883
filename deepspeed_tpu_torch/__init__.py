"""PyTorch/CUDA port of ``deepspeed_tpu``.

Kept beside the JAX package, with its module paths and names, and
independent of it: nothing here imports ``jax`` or ``deepspeed_tpu``.  Plain
tensor code is PyTorch; every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (``csrc/``), built at first use.  Entry
points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
