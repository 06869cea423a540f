"""The rate of the ring's copies between cards in the traced window: the
program's counter ``ring.bytes_shipped`` (the vectors and norms of every
block put on a copy to the next card) over the summed device time of the
peer copies, the trace's ``Memcpy PtoP`` operations (each card's copies
counted on their own, so it is the rate of one link), in GB/s. Nothing
where the window has no peer copy (logical positions of one card) or the
program no such counter. Reads every ``peer_gbps.<group>``."""
from knnbench import program_spans

PEER_COPY = "Memcpy PtoP"


def read(rec):
    t = rec.trace
    shipped = program_spans.counter("ring.bytes_shipped")
    if t is None or not shipped:
        return None
    seconds = sum(s for name, s in t["device_ops"] if name.startswith(PEER_COPY))
    return shipped / seconds / 1e9 if seconds > 0 else None
