from repro_torch.data.loader import DataLoader, LoaderConfig, SkipLedger
from repro_torch.data.autotune import autotune_workers
