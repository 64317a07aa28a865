"""``decode_roofline.scan``: the least time of a whole-index decode, the
bytes it must move (``roofline.decode_bytes``) over the card's published
memory rate, as a share of the device's busy time a chained run in the
traced slice (the launch and the checksum ops together, so the share
stays valid whatever kernels do the work)."""

from benchmark import roofline


def read(r):
    prof, nbytes = r.profile, r.facts.get("decode_bytes")
    rate = roofline.hbm_rate(r.device_kind)
    if not prof or not prof["busy_s"] or not nbytes or not rate or not r.work:
        return None
    return 100.0 * (nbytes / rate) / (prof["busy_s"] / r.work)
