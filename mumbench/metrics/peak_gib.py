"""peak_gib: torch.cuda.max_memory_allocated over the timed window, after
a reset at its start, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
