"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, llama-style GQA. (the reference
package's configs/yi_34b.py)."""
import dataclasses

from repro_torch.models import base, dense

CFG = base.ArchConfig(
    arch_id="yi-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    rope_theta=5_000_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=112, vocab=251)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(
        cfg=CFG, module=dense, reduced=REDUCED,
        skip_cells=("long_500k",),
        skip_reasons={"long_500k": "pure full attention: every layer's "
                      "KV cache is O(context); sub-quadratic attention "
                      "required for the 500k cell (DESIGN.md)"},
    )


base.register("yi-34b", bundle)
