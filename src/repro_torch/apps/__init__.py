"""PARSEC case-study applications re-implemented in PyTorch (paper §3.1).

Each module exposes
    make_inputs(n: int, seed: int, device=None) -> dict of input tensors
    run(inputs, device=None) -> dict of output tensors
    flops(n: int) -> float                     (napkin work estimate)
    DEFAULT_N: int                             (smoke-test size)

`n` plays the role of the paper's input-size knob. Inputs are drawn with
numpy from `seed`, exactly as the JAX package draws them, then placed on
the device; swaptions' Monte-Carlo shocks come from a `torch.Generator`
seeded from `seed` on the run's device. `device=None` is the CUDA device
(raises without one); pass `device="cpu"` for the host.
"""

from repro_torch.apps import blackscholes, fluidanimate, raytrace, swaptions

APPS = {
    "blackscholes": blackscholes,
    "fluidanimate": fluidanimate,
    "raytrace": raytrace,
    "swaptions": swaptions,
}
