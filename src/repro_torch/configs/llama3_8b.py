"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256. (the reference
package's configs/llama3_8b.py)."""
import dataclasses

from repro_torch.models import base, dense

CFG = base.ArchConfig(
    arch_id="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=128256,
    rope_theta=500_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab=263)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(
        cfg=CFG, module=dense, reduced=REDUCED,
        skip_cells=("long_500k",),
        skip_reasons={"long_500k": "pure full attention (DESIGN.md)"},
    )


base.register("llama3-8b", bundle)
