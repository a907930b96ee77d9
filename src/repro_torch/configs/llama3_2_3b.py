"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 (the reference package's configs/llama3_2_3b.py)."""
import dataclasses

from repro_torch.models import base, dense

CFG = base.ArchConfig(
    arch_id="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=128256,
    rope_theta=500_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
    d_ff=96, vocab=263)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(
        cfg=CFG, module=dense, reduced=REDUCED,
        skip_cells=("long_500k",),
        skip_reasons={"long_500k": "pure full attention (DESIGN.md)"},
    )


base.register("llama3.2-3b", bundle)
