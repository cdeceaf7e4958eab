"""PGAbB's in-core block engine on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100: the host side
(graph, partition, block store, scheduler) is numpy, the iteration
runs on torch tensors, and the dense tile paths run hand-written CUDA
kernels (``csrc/``) built at first use.  Entry point::

    from repro_torch.core import build_block_store, compile_plan, rmat
    from repro_torch.algorithms import pagerank_algorithm

    plan = compile_plan(pagerank_algorithm(), build_block_store(rmat(12), 8))
    ranks = plan.run().result          # on the card; device="cpu" for the CPU
"""
