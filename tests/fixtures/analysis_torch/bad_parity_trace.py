"""Fixture: a _KIND_ORDER trace kind with no fold-side producer: the
engine emits ``ghost`` but ``reconstruct_traces`` never rebuilds it from
the fold's records, so event-level parity is unprovable for it."""

_KIND_ORDER = {"failure": 0, "ghost": 1}


class Recorder:
    def emit(self, t, kind):
        pass


def run_engine(rec, t):
    rec.emit(t, "failure")
    rec.emit(t, "ghost")


def reconstruct_traces(rec, t):
    rec.emit(t, "failure")
