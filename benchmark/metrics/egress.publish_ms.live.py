"""egress (``io/zmqpub.EgressHub.publish_outputs``): the median time a
window block outside the profiled slice spends publishing its topics on
ZMQ, from a wrapper around that method, in ms."""

import statistics


def read(t):
    spans = t.spans.get("egress.publish")
    if t.kind != "live" or not spans:
        return None
    return statistics.median(spans) * 1e3
