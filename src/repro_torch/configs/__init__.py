"""Architecture configs.  Importing this package registers every config
the port carries so far."""
from repro_torch.configs import (deepseek_v2_236b,  # noqa: F401
                                 deepseek_v2_lite_16b, gemma3_4b,
                                 internvl2_2b, llama3_2_3b, llama3_8b,
                                 recurrentgemma_9b, whisper_large_v3,
                                 xlstm_350m, yi_34b)
