"""The most device memory allocated from the end of making the inputs to the
close of the window (PyTorch's CUDA allocator's record of the card's
allocations: the program's set-up, warm calls and window, with whatever
inputs lie on the card), in GB. Nothing to read without a card."""


def read(obs):
    return obs.program_peak_bytes / 1e9 if obs.program_peak_bytes else None
