"""refresh_launches: device activities (kernels, copies, sets) launched
inside the ``bench.refresh`` span, per batch of the traced window."""


def read(view):
    t = view.trace
    if not t or not t.get("batches"):
        return None
    n = t["span_activities"].get("bench.refresh", 0)
    if not n:
        return None
    return n / t["batches"]
