"""fsm_roofline_pct: the least time an H100 could take for a batch's FSM
replay (``yardstick/roofline.py``: bytes at 3.35 TB/s or operations at
the assumed int32 rate, whichever is larger) as a share of the device
time of the activities launched inside the ``bench.replay`` span, per
batch of the traced window. Published peaks assume the card's 700 W
limit; the result line's ``device.power_limit`` states the card's."""


def read(view):
    t = view.trace
    if not t or not t.get("batches"):
        return None
    device_s = t["span_device_s"].get("bench.replay", 0.0) / t["batches"]
    if device_s <= 0:
        return None
    return 100.0 * view.work()["least_s"] / device_s
