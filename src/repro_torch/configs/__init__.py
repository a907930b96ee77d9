"""Architecture configs.  Importing this package registers every config
the port carries so far."""
from repro_torch.configs import llama3_2_3b, recurrentgemma_9b  # noqa: F401
