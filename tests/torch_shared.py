"""Reference results the port's tests compute once for every pytest-xdist
worker.

Under ``-n N`` every worker runs its own share of a module's tests and
sets up a module fixture anew, so a JAX reference drive two workers need
was computed twice. :func:`shared_arrays` follows pytest-xdist's recipe
for session data: the first worker that needs a result computes it and
writes it as ``.npz`` beside the workers' temporary directories, under a
file lock; a worker that comes later reads it (one that comes while it is
being computed waits for it). Outside xdist the result is computed where
it is needed."""

import numpy as np


def shared_arrays(request, name: str, compute) -> dict:
    """``compute()`` (a dict of numpy arrays) for the test of ``request``,
    computed once a test session under pytest-xdist."""
    if not hasattr(request.config, "workerinput"):
        return compute()
    from filelock import FileLock

    root = request.getfixturevalue("tmp_path_factory").getbasetemp().parent
    path = root / f"{name}.npz"
    with FileLock(f"{path}.lock"):
        if not path.is_file():
            np.savez(path, **compute())
        with np.load(path) as f:
            return {key: f[key] for key in f.files}
