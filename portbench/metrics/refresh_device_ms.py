"""refresh_device_ms: device milliseconds of the activities launched
inside the ``bench.refresh`` span, summed, per batch of the traced
window."""


def read(view):
    t = view.trace
    if not t or not t.get("batches"):
        return None
    device_s = t["span_device_s"].get("bench.refresh", 0.0)
    if device_s <= 0:
        return None
    return device_s / t["batches"] * 1e3
