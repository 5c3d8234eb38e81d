"""A frozen copy of the port's plain PyTorch path: the modules the reference
needs (filter step, fleet draw, front-end, live tracker), with the three
CUDA kernels replaced by their plain versions (``ops/plain_kernels.py``)
and the CUDA-graph runner by plain loops. It imports nothing of the
program, so a later change to the program is judged against it."""
