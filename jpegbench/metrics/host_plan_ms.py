"""host_plan_ms: the producer's parse + plan_frame (host.parser.parse and
engine.device_entropy.plan_frame: destuff and windows, or build_plan), mean
host ms a frame over the traced window."""


def read(o):
    plan = o.spans.get("producer.plan")
    if not plan:
        return None
    return sum(plan) / len(plan) * 1e3
