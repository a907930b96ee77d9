"""Architecture configs.  Importing this package registers every config
the port carries so far."""
from repro_torch.configs import (deepseek_v2_236b,  # noqa: F401
                                 deepseek_v2_lite_16b, gemma3_4b,
                                 llama3_2_3b, llama3_8b, recurrentgemma_9b,
                                 yi_34b)
