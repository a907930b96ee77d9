"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 -- InternViT frontend (stub: precomputed patch embeddings)
+ InternLM2 decoder (the reference package's configs/internvl2_2b.py)."""
import dataclasses

from repro_torch.models import base, vlm

CFG = base.ArchConfig(
    arch_id="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92553,
    enc_len=256, frontend_dim=1024, rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
    d_ff=96, vocab=251, enc_len=6, frontend_dim=16)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(
        cfg=CFG, module=vlm, reduced=REDUCED,
        skip_cells=("long_500k",),
        skip_reasons={"long_500k": "full-attention LM decoder "
                      "(DESIGN.md)"},
    )


base.register("internvl2-2b", bundle)
