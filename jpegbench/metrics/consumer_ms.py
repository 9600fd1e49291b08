"""consumer_ms: the consumer's host ms a decoded frame over the traced
window: engine.device_entropy.decode_frame (with the wait for the scan's
verdict) and the pixel stage (engine.pipeline.decode_rgb_soa), with the
harness's event and flag reduction."""


def read(o):
    dec = o.spans.get("consumer.decode_frame", [])
    rgb = o.spans.get("consumer.decode_rgb", [])
    if not dec or o.kind != "stream":
        return None
    return (sum(dec) + sum(rgb)) / len(dec) * 1e3
