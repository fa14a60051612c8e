"""Command-line simulation driver of the PyTorch port.

``python -m parasitoids_tpu_torch [flags] [key=value ...]`` takes the flags
of ``python -m parasitoids_tpu`` (``--pop``, ``--kalbar``, ``--carnarvon``,
``key=value`` overrides, ...), prints the same phase timings, checks the
fields with ``validate_fields`` and saves reference-format npz/json through
``io.save.save_run``.  ``--device cpu|cuda`` (default ``cuda``) picks the
device; it is read before the ``Params`` flags and overrides, and there is
no CPU fallback when no card is visible.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .config import Params
from .io import save_run
from .models.forward import setup_forward, simulate
from .utils.checks import validate_fields

_USAGE = """\
usage: python -m parasitoids_tpu_torch [flags] [key=value ...]

flags:
  --device cpu|cuda       where to run (default cuda; no CPU fallback)
  --pop / --prob          population vs single-wasp probability model
  --kalbar / --carnarvon  dataset preset (release schedule, wind files)
  --plot / --no_plot      write per-day figures after the run
  --output / --no_output  save <outfile>.npz + .json (reference format)

key=value overrides set any Params field, e.g.:
  ndays=5 'domain_info=(8000.0,320)' n_periods=20 outfile=output/run
  use_f64=True            float64 validation mode (plain accumulate)
  use_pallas=False        plain torch accumulate instead of the CUDA kernel
  ref_trunc=True          the reference's 0.999-mass ring truncation of
                          every block (a parity mode; plain accumulate)
"""


def split_device(argv):
    """``(device, rest)``: the ``--device cpu|cuda`` flag (default
    ``cuda``) taken out of a command line, and the arguments left for
    ``Params.cmd_line_chg``."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument('--device', choices=('cpu', 'cuda'), default='cuda')
    ns, rest = parser.parse_known_args(list(argv))
    return ns.device, rest


def _route(setup):
    if setup.kcfg.ref_trunc:
        return 'plain torch accumulate (ref_trunc)'
    if setup.kcfg.pallas:
        return 'CUDA day kernel'
    if setup.wind_flat.dtype == torch.float64:
        return 'plain torch accumulate (f64)'
    return 'plain torch accumulate'


def main(params: Params | None = None, argv=None, device=None):
    """Run the CLI; ``device`` given here wins over ``--device``."""
    if argv is None:
        argv = sys.argv[1:] if params is None else []
    if params is None and any(a in ('-h', '--help') for a in argv):
        print(_USAGE)
        return None, None
    flag, argv = split_device(argv)
    device = flag if device is None else device
    if params is None:
        params = Params()
        if argv:
            params.cmd_line_chg(argv)

    tic_total = time.time()
    setup = setup_forward(params, device=device)
    print('Simulating {} days of {} on a {}x{} grid ({} model) on {}, '
          'day accumulate: {}...'.format(
              setup.ndays, params.site_name, setup.scfg.dom_len,
              setup.scfg.dom_len,
              'probability' if params.PROB_MODEL else 'population',
              setup.wind_flat.device, _route(setup)))
    if setup.kcfg.ref_trunc:
        print('ref_trunc: every block and the local kernel are cut to the '
              'reference\'s 0.999-mass ring (a mode of the reference), '
              'accumulated by the plain torch path: no CUDA kernel launch')

    timing = {}
    fields, days = simulate(params, setup, timing=timing)
    print('Kernel phase: {:.3f} s'.format(timing['kernel_phase']))
    print('Convolution phase: {:.3f} s'.format(timing['conv_phase']))
    print('Total time elapsed: {:.3f} s'.format(time.time() - tic_total))

    # numerical sanitizers (ref ParasitoidModel.py:528-599 assertion layer)
    host = fields.cpu().numpy()
    validate_fields(host, params, params.PROB_MODEL)

    if params.OUTPUT:
        print('Saving to {}...'.format(params.outfile))
        save_run(params.outfile, host, days, params)

    if params.PLOT:
        from .viz.plot_result import plot_all
        plot_all(host, days, params)

    return fields, days


if __name__ == '__main__':
    main()
