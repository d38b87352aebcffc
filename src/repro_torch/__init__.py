"""MINT in PyTorch for one NVIDIA H100: the port of ``repro`` (JAX/TPU).

The package mirrors ``repro``'s module layout and names. Module boundaries
take and return numpy where the reference does; inside, it is PyTorch on an
explicit device. Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version instead.
"""
