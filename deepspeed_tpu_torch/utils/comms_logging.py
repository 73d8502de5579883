"""Communication logging (JAX ``deepspeed_tpu/utils/comms_logging.py``).

Per-(op, message size) count, latency, algorithmic and bus bandwidth,
summarized by ``log_summary`` and ``as_events``.  Host arithmetic and
bookkeeping only.  The single-GPU port runs no collective to log:
``comms_logger.enabled: true`` in a training config raises
``NotImplementedError`` (ROADMAP item 11), so this module is what the
multi-GPU facade will feed.
"""

from collections import defaultdict

from .logging import logger


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float, n: int):
    """Algorithmic and bus bandwidth in Gbps: the bus figure scales the
    algorithmic one by the ring collectives' traffic factor, (n-1)/n for
    all-gather, reduce-scatter and all-to-all, twice that for all-reduce."""
    duration_s = max(duration_s, 1e-12)
    tput = size_bytes / duration_s  # bytes/s
    if comm_op in ("all_gather", "reduce_scatter", "all_to_all"):
        busbw = tput * ((n - 1) / max(n, 1))
    elif comm_op == "all_reduce":
        busbw = tput * (2 * (n - 1) / max(n, 1))
    else:  # pt2pt, broadcast
        busbw = tput
    # convert to Gbps
    return tput * 8 / 1e9, busbw * 8 / 1e9


class CommsLogger:
    """Per-op and per-size stats store."""

    def __init__(self, enabled=False, verbose=False, prof_all=True, prof_ops=None, debug=False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.debug = debug
        # comms_dict[op_name][size] = [count, [latencies], [algbw], [busbw]]
        self.comms_dict = defaultdict(lambda: defaultdict(lambda: [0, [], [], []]))
        # traced_dict[op_name][size] = trace-time occurrence count
        self.traced_dict = defaultdict(lambda: defaultdict(int))

    def configure(self, config):
        self.enabled = config.enabled
        self.verbose = config.verbose
        self.prof_all = config.prof_all
        self.prof_ops = list(config.prof_ops)
        self.debug = config.debug

    def should_profile(self, op_name: str) -> bool:
        if not self.enabled:
            return False
        return self.prof_all or op_name in self.prof_ops

    def append(self, raw_name: str, record_name: str, latency_s: float, msg_size: int, world: int):
        algbw, busbw = calc_bw_log(raw_name, msg_size, latency_s, world)
        entry = self.comms_dict[record_name][msg_size]
        entry[0] += 1
        entry[1].append(latency_s * 1000.0)
        entry[2].append(algbw)
        entry[3].append(busbw)
        if self.verbose:
            logger.info(f"comm op: {record_name} | time (ms): {latency_s*1000:.2f} | "
                        f"msg size: {msg_size} | algbw (Gbps): {algbw:.2f} | busbw (Gbps): {busbw:.2f}")

    def record_traced(self, op_name: str, msg_size: int):
        self.traced_dict[op_name][msg_size] += 1

    def as_events(self, step: int):
        """Per-op stats as monitor ``(tag, value, step)`` events: a count,
        mean latency and mean bus bandwidth for each op over its sizes, and
        the traced collectives' counts."""
        events = []
        for record_name, sizes in sorted(self.comms_dict.items()):
            count = sum(entry[0] for entry in sizes.values())
            lats = [l for entry in sizes.values() for l in entry[1]]
            bus = [b for entry in sizes.values() for b in entry[3]]
            events.append((f"Comms/{record_name}/count", float(count), step))
            if lats:
                events.append((f"Comms/{record_name}/avg_latency_ms",
                               sum(lats) / len(lats), step))
            if bus:
                events.append((f"Comms/{record_name}/avg_busbw_gbps",
                               sum(bus) / len(bus), step))
        for op, sizes in sorted(self.traced_dict.items()):
            events.append((f"Comms/traced/{op}/count",
                           float(sum(sizes.values())), step))
        return events

    def log_summary(self, show_straggler=False):
        lines = [f"{'Comm. Op':<20}{'Message Size':<20}{'Count':<10}"
                 f"{'Total Latency(ms)':<20}{'Avg Latency(ms)':<20}{'tput_avg (Gbps)':<20}{'busbw_avg (Gbps)':<20}"]
        for record_name, sizes in sorted(self.comms_dict.items()):
            lines.append(record_name)
            for size, (count, lats, alg, bus) in sorted(sizes.items()):
                total = sum(lats)
                avg = total / max(count, 1)
                lines.append(f"{'':<20}{size:<20}{count:<10}{total:<20.2f}{avg:<20.2f}"
                             f"{sum(alg)/max(len(alg),1):<20.2f}{sum(bus)/max(len(bus),1):<20.2f}")
        if self.traced_dict:
            lines.append("traced (in-graph) collectives — counts at trace time:")
            for op, sizes in sorted(self.traced_dict.items()):
                for size, count in sorted(sizes.items()):
                    lines.append(f"{'':<4}{op:<16}{size:<20}{count:<10}")
        summary = "\n".join(lines)
        logger.info("\n" + summary)
        return summary


_COMMS_LOGGER = None


def get_comms_logger() -> CommsLogger:
    global _COMMS_LOGGER
    if _COMMS_LOGGER is None:
        _COMMS_LOGGER = CommsLogger()
    return _COMMS_LOGGER
