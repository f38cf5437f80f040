"""histories_per_s: the histories whose state and refreshed tasks were
complete on the card within the window, over the window's seconds (host
clock, from the window's start to its closing synchronise)."""


def read(view):
    w = view.window
    if not w.batches or w.seconds <= 0:
        return None
    return w.batches * view.lanes / w.seconds
