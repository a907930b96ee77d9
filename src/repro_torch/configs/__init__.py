"""Architecture configs (port of :mod:`repro.configs`).  Importing this
package registers every architecture with the model registry (``--arch
<id>`` in the launcher)."""
from repro_torch.configs import (deepseek_v2_236b,  # noqa: F401
                                 deepseek_v2_lite_16b, gemma3_4b,
                                 internvl2_2b, llama3_2_3b, llama3_8b,
                                 paper, recurrentgemma_9b, whisper_large_v3,
                                 xlstm_350m, yi_34b)

ALL_ARCHS = (
    "gemma3-4b", "yi-34b", "llama3.2-3b", "llama3-8b", "recurrentgemma-9b",
    "deepseek-v2-lite-16b", "deepseek-v2-236b", "xlstm-350m",
    "internvl2-2b", "whisper-large-v3",
)
