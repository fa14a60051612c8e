"""Library-level durable artifact persistence, the port's copy of
``parasitoids_tpu/utils/durable.py`` (host only).

Long chains run on hosts that can be recycled without warning, and a
recycle erases everything gitignored.  Every checkpoint and trace writer
(bayes/run.py) can make its artifacts durable the moment they land,
without a wrapper script.

Durability = a git commit: ``commit_artifacts`` force-adds the given paths
(they are typically gitignored run artifacts) and commits, serialized
against concurrent writers via the same flock the chain scripts use.  It is
**off by default** (tests and ad-hoc runs must not spam the repo history)
and enabled by ``PARA_GIT_COMMIT=1`` in the environment; failures are
reported, never raised — losing durability must not kill a multi-hour
chain.

The reference has no analog: its PyMC HDF5 store (Bayes_Run.py:500-503)
flushes to local disk and stops there.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

__all__ = ['durability_enabled', 'commit_artifacts']

_LOCK_NAME = 'para_git.lock'        # in the temporary directory


def durability_enabled():
    """True when the environment opts into commit-on-landing."""
    return os.environ.get('PARA_GIT_COMMIT', '') == '1'


def commit_artifacts(paths, message, cwd=None, force=True, timeout=120):
    """Force-add ``paths`` (those that exist) and commit with ``message``.

    No-op (returns False) unless ``durability_enabled()``.  Serialized on
    the chain scripts' flock so a background chain and an interactive
    shell never interleave index operations.  Returns True on a commit,
    False otherwise; never raises.
    """
    if not durability_enabled():
        return False
    existing = [p for p in paths if os.path.exists(p)]
    if not existing:
        return False
    add = ['git', 'add'] + (['-f'] if force else []) + ['--'] + existing
    try:
        with open(os.path.join(tempfile.gettempdir(), _LOCK_NAME),
                  'w') as lock:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass   # no flock on this platform: proceed unserialized
            r = subprocess.run(add, cwd=cwd, capture_output=True,
                               timeout=timeout)
            if r.returncode != 0:
                print('durable-commit: git add failed: {}'.format(
                    r.stderr.decode(errors='replace').strip()), flush=True)
                return False
            # nothing staged -> nothing to commit (quiet success)
            r = subprocess.run(['git', 'diff', '--cached', '--quiet'],
                               cwd=cwd, timeout=timeout)
            if r.returncode == 0:
                return False
            r = subprocess.run(['git', 'commit', '-q', '-m', message],
                               cwd=cwd, capture_output=True, timeout=timeout)
            if r.returncode != 0:
                print('durable-commit: git commit failed: {}'.format(
                    r.stderr.decode(errors='replace').strip()), flush=True)
                return False
            return True
    except (OSError, subprocess.SubprocessError) as e:
        print('durable-commit: {}'.format(e), flush=True)
        return False
