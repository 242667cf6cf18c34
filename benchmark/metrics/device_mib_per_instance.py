"""device_mib_per_instance (MiB): torch.cuda.max_memory_allocated() over
set-up and window, over the batch's instances: how many filters a card
holds."""


def read(rec):
    peak = rec["memory_peak_bytes"]
    return None if peak is None else peak / rec["instances"] / 2**20
