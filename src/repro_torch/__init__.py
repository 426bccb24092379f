"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The paper's pipeline (power fit, ε-SVR characterization, the engine's
(f, cores) argmin and frontier, the governor comparison) and the model
zoo's LM serving path (starcoder2-3b, mamba2-130m: prefill and greedy
decode) run on the card, with their Pallas kernels rewritten by hand for
``sm_90a`` (``kernels/csrc/``). The package imports torch and numpy only.
"""
