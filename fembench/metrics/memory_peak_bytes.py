"""The device's peak of allocated bytes over set-up and the window, as the
CUDA caching allocator records it (``torch.cuda.max_memory_allocated``),
read once the window has closed; silent without a card."""


def read(rec):
    return float(rec.memory_peak) if rec.memory_peak else None
