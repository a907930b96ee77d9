"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512 q_lora=1536, 160 routed experts top-6 +
2 shared, dense layer 0 (d_ff 12288). (the reference
package's configs/deepseek_v2_236b.py)."""
import dataclasses

from repro_torch.models import base, moe

CFG = base.ArchConfig(
    arch_id="deepseek-v2-236b", family="moe", n_layers=60,
    d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128, d_ff=1536,
    vocab=102400, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    n_experts=160, n_shared_experts=2, top_k=6, capacity_factor=2.0,
    d_ff_dense=12288, rope_theta=10_000.0,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    rope_head_dim=8, kv_lora_rank=24, q_lora_rank=32, d_ff=32,
    d_ff_dense=96, vocab=257, n_experts=8, top_k=2)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(
        cfg=CFG, module=moe, reduced=REDUCED,
        skip_cells=("long_500k",),
        skip_reasons={"long_500k": "MLA is full attention: latent cache "
                      "is O(context) (DESIGN.md)"},
    )


base.register("deepseek-v2-236b", bundle)
