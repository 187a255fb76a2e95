"""The Karp-Rabin phrase-break mask's work (the program's
kernels/kr_mask.break_mask): for a text of n_text characters and a window
of w, the decorated text (one leading separator, the text, w trailing
separators) is read once and one mask byte per position of it is written
once, plus the 4-byte break count. Padding that an implementation adds is
not work. The integer hash arithmetic is not counted as floating-point
operations, so the memory bound is the roofline."""

KERNEL = "break_mask_kernel"  # the profiler's kernel name contains this


def bytes_moved(n_text: int, w: int) -> int:
    n_ext = n_text + 1 + w
    return 2 * n_ext + 4
