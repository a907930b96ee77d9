"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 --
alternating mLSTM (matrix memory) + sLSTM blocks (the reference
package's configs/xlstm_350m.py)."""
import dataclasses

from repro_torch.models import base, xlstm

CFG = base.ArchConfig(
    arch_id="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, head_dim=256, d_ff=0, vocab=50304,
    pattern=("mlstm", "slstm"), conv_width=4,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=4, d_model=32, n_heads=4, head_dim=8, vocab=251)


def bundle() -> base.ArchBundle:
    return base.ArchBundle(cfg=CFG, module=xlstm, reduced=REDUCED)


base.register("xlstm-350m", bundle)
