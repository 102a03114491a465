"""Host milliseconds around ``EventEngine.run``, before the wait, per step,
over the untraced window's batches. When the device is behind, this
includes the time the host waits for room in the launch queue."""


def read(record: dict) -> float:
    batches = record["batches"]
    return 1e3 * sum(b.enqueue_s for b in batches) / (len(batches) * record["steps"])
