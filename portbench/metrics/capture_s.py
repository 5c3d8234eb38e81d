"""capture_s: seconds of the path's first call, which captures its CUDA
graphs (``ops/cuda_graph.StepGraph``); a part of set-up."""


def read(run, variant):
    return run["capture_s"]
