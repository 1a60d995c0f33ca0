"""Which accelerator a run is on, for scripts that report device numbers."""

from __future__ import annotations

import subprocess

_QUERY = ['nvidia-smi', '--query-gpu=name,power.limit',
          '--format=csv,noheader']


def card_line():
    """GPU 0's name and power limit as ``nvidia-smi`` prints them.

    Runs in a child process that never touches JAX; returns a line that
    says so when nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(_QUERY, capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return 'unknown card (nvidia-smi: %s)' % err
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else 'unknown card (nvidia-smi printed nothing)'


def require_gpu(devices):
    """Exit non-zero unless JAX's first device is a GPU."""
    if not devices or devices[0].platform != 'gpu':
        found = ', '.join(sorted({d.platform for d in devices})) or 'none'
        raise SystemExit('no GPU found (JAX devices: %s)' % found)
    return devices[0]
