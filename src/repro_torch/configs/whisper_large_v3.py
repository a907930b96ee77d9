"""whisper-large-v3 [audio]: enc-dec, 32+32L d_model=1280 20H (MHA)
d_ff=5120 vocab=51866, conv frontend stub (precomputed frame embeddings,
enc_len=1500), plain-GELU MLPs (the reference package's
configs/whisper_large_v3.py)."""
import dataclasses

from repro_torch.models import base, whisper

CFG = base.ArchConfig(
    arch_id="whisper-large-v3", family="audio", n_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120,
    vocab=51866, enc_layers=32, enc_len=1500, mlp_gated=False,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=2, enc_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
    head_dim=12, d_ff=96, vocab=251, enc_len=12)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(cfg=CFG, module=whisper, reduced=REDUCED)


base.register("whisper-large-v3", bundle)
