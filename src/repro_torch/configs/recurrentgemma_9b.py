"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 -- RG-LRU + local attention, 1 attn : 2 rec (the
reference package's configs/recurrentgemma_9b.py)."""
import dataclasses

from repro_torch.models import base, rglru

CFG = base.ArchConfig(
    arch_id="recurrentgemma-9b", family="hybrid", n_layers=38,
    d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
    vocab=256000, pattern=("rec", "rec", "local"), window=2048,
    lru_width=4096, conv_width=4,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=5, d_model=48, n_heads=4, n_kv_heads=1, head_dim=12,
    d_ff=96, vocab=251, window=8, lru_width=48)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(cfg=CFG, module=rglru, reduced=REDUCED)


base.register("recurrentgemma-9b", bundle)
