"""The SSD backward kernels' share of their roofline in training: each
backward call's least time over the device time of the kernels whose name
holds ``ssd_bwd`` (its intra-chunk kernel and its state kernel; the
reverse scan's torch ops between them are not counted). A call is one
layer's backward, one count of ``LAUNCHES["ssd_bwd"]``.

A call's work is twice the forward's products, each counted as
``flops.ssd_chunks_launch`` and the forward's state passing count them:
dC = dS B and dB = dSᵀ C once a group, and dM = dY xᵀ and dx = Mᵀ dY a head,
on each chunk's causal triangle; x Gᵀ, (B ∘ w) G, dY Hᵀ and Z = (C ∘
e^cum)ᵀ dY a head at T·n·p (S recomputed is not counted, as
``flops.train_step`` counts training), at the TF32 peak, which bounds
f32-exact work done as 3xTF32 too; or its f32 bytes at the memory's rate:
x, dY and dx (b·h, nc, T, p), the entry states H, their gradients G and Z
(b·h, nc, n, p), B, C, dB and dC (b, nc·T, g, n), dt and ddt (b·h, nc,
T), each once. A parent whose backward is the plain VJP counts no
``ssd_bwd`` launch, and the reading is None."""

from chipbench import flops, peaks, readers


def work(cfg, b, s):
    m = flops.dims(cfg)
    T = cfg["chunk_size"]
    nc = -(-s // T)
    h, g, n, p = m["heads"], m["g"], m["n"], m["p"]
    tri = flops.causal_pairs(T)
    ops = 2.0 * b * nc * (2.0 * g * tri * n + h * (2.0 * tri * p + 4.0 * T * n * p))
    n_bytes = 4.0 * (3 * b * h * nc * T * p + 3 * b * h * nc * n * p + 4 * b * nc * T * g * n
                     + 2 * b * h * nc * T)
    return ops, n_bytes


def read(rec):
    return readers.roofline(rec, "ssd_bwd", "ssd_bwd", work, peaks.TF32_OPS_PER_S)
