"""Set-up: from the process's start (imports included) to the window's,
through data, service, ingest and the warm-up of every batch shape."""


def read(run):
    return run.setup_s
