"""Device milliseconds per engine step of everything but the delivery
kernels: the neuron step, the delivery's glue (queue, arbitration, stats),
the input building and the readout."""

from perfbench.readings import kernel, traced_steps

DELIVERY_KERNELS = ("fused_deliver", "fabric_deliver", "cam_match")


def read(record: dict) -> float:
    trace = record["trace"]
    delivery = sum(kernel(trace, name)[0] for name in DELIVERY_KERNELS)
    return 1e3 * (trace["busy_s"] - delivery) / traced_steps(trace)
