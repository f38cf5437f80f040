"""setup_s: seconds from the process's start to the window's: imports,
the kernel library's load (its build in a checkout's first run), the
histories' generation and packing, the tiling on the card, the
checkpoint prefix's replay where the traffic resumes, and a warm-up
window of 4 batches."""


def read(view):
    return view.setup_s
