"""Reduced twins of the benchmark's configuration and mixes, small enough
for the CPU: the published layer equations at toy widths."""
import dataclasses
import json
from pathlib import Path

from hbm_bench import loadgen

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

# The twin's own limit on the widest served-token logit gap, set as the
# cell's is: the program reads 0.012-0.020 and the float8 control
# 0.089-0.234 on the twin (seeds 2**31 + 4321 .. + 4325, on the CPU).
TWIN_LIMIT = 0.045


def yi_twin(voltage=None) -> dict:
    cfg = json.loads((CONFIGS / "yi-34b.json").read_text())
    cfg.update(hidden_size=56, num_attention_heads=7, num_key_value_heads=1,
               head_dim=8, intermediate_size=112, vocab_size=251,
               num_hidden_layers=3, checks={"max_logit_gap": TWIN_LIMIT})
    if voltage is not None:
        cfg["deployment"]["kv_voltage"] = voltage
    return cfg


def yi_mix(**kw):
    mix = dataclasses.replace(
        loadgen.load_mix("reasoning-closed8"), clients=4, max_len=64,
        prefill_chunk=16,
        prompt_len=loadgen.Lengths(median=16, sigma=0.5, min=4, max=30),
        output_len=loadgen.Lengths(median=14, sigma=0.5, min=8, max=30),
        strata=4, trace_steps=4, trace_kind="decode", sample_tokens=60,
        sample_max=16)
    return dataclasses.replace(mix, **kw)
