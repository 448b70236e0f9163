"""peak_device_gib.index: the most device memory the program held at once
during the window (`torch.cuda.max_memory_allocated` after a reset at the
window's opening), in GiB."""


def read(ctx):
    return ctx["peak_window_bytes"] / 2**30
