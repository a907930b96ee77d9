"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5 local : 1 global, 128k context. (the reference
package's configs/gemma3_4b.py)."""
import dataclasses

from repro_torch.models import base, dense

CFG = base.ArchConfig(
    arch_id="gemma3-4b", family="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, head_dim=256, d_ff=10240, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, rope_theta=1_000_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=257, window=8)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(cfg=CFG, module=dense, reduced=REDUCED)


base.register("gemma3-4b", bundle)
