"""parse_ms: the program's span host.parse (host.parser.parse, on the
producer's thread), mean ms a parse over the traced window."""

from jpegbench import program_spans as ps


def read(o):
    parses = ps.spans(ps.snapshot(o), ["host.parse"])
    return ps.wall_ns(parses) / len(parses) / 1e6 if parses else None
