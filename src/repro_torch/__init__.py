"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The paper's pipeline (power fit, ε-SVR characterization, the engine's
(f, cores) argmin and frontier, the governor comparison) runs on the card,
with its three Pallas kernels rewritten by hand for ``sm_90a``
(``kernels/csrc/``). The package imports torch and numpy only.
"""
