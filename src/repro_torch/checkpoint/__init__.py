"""Store-backed checkpoints of train state."""
from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: F401
                                                 CheckpointConfig)
