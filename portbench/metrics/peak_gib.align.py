"""Peak of the memory the program held on the card from the window's start
to the end of the traced slice, torch.cuda.max_memory_allocated() (the
allocator's counter)."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2**30
