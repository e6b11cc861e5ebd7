"""Fixture: a PROCESS_KINDS entry whose dispatch arm is missing: ``doom``
is declared and constructed but ``gen`` never compares against it, so its
events would silently generate nothing on the engine and the fold."""

PROCESS_KINDS = ("periodic", "doom")


class FailureProcessSpec:
    def __init__(self, kind, params=None):
        self.kind = kind
        self.params = params or {}


def gen(proc):
    if proc.kind == "periodic":
        return [600.0]
    raise ValueError(proc.kind)


SPECS = [FailureProcessSpec("periodic"), FailureProcessSpec("doom")]
