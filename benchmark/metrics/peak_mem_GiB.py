"""torch.cuda.max_memory_allocated() over the untraced window, reset at its start,
in GiB."""


def read(run):
    return run.window['peak_bytes'] / 2 ** 30
