"""Simulation configuration (L0).

Re-implements the parameter surface of the reference ``Params`` class
(Run.py:34-385) with the same layered precedence:

    class defaults -> dataset preset -> config.txt -> CLI args -> saved JSON

Parameter names and the on-disk JSON format are kept compatible with the
reference so saved runs interoperate (Run.py:512-516, Run.py:355-368).  The
reference's silent-no-op bug for ``r_start``/``r_number`` CLI overrides
(``==`` instead of ``=`` at Run.py:293-295) is intentionally fixed here.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Tuple


class Params:
    """All model/run parameters plus parsing helpers.

    Class-level flags are shared across instances, as in the reference
    (Run.py:36-39).  ``CUDA`` is kept for config compatibility but simply
    means "use the accelerator" — on this stack the accelerator path is the
    default jitted TPU path and the flag is ignored by the solver.
    """

    OUTPUT = True
    PLOT = True
    CUDA = True

    def __init__(self):
        ### MODEL TYPE
        self.PROB_MODEL = True

        ### I/O — dataset presets: 'kalbar', 'carnarvon' or None
        self.dataset: Optional[str] = 'kalbar'
        self.my_datasets()

        # (dist (m), cells) from release point to side of the domain
        self.domain_info: Tuple[float, int] = (10000.0, 400)  # 25 m resolution
        # interpolation points per wind reading (30 -> 1-minute resolution)
        self.interp_num = 30
        # >= 0 limits the simulation to the first n days
        self.ndays = -1

        ### take-off probability function parameters
        # g: wind logistic (aw: half-max wind speed, bw: steepness)
        self.g_params = (1.263, 3.913)
        # f: time-of-day logistics (a1,b1 morning; a2,b2 afternoon)
        self.f_params = (7.302, 2.614, 23.999, 2.350)
        # in-flow diffusion (sig_x, sig_y, rho) in meters
        self.Dparams = (171.82, 144.58, 0.253)
        # out-of-flow (local) diffusion
        self.Dlparams = (7.096, 7.260, 0.000)

        ### flight parameters
        self.lam = 1.       # flight probability under ideal conditions
        self.mu_r = 1.179   # flight advection / wind advection scaling
        self.n_periods = 30  # interp periods per flight (minutes if interp_num=30)

        ### satellite imagery (viz only)
        self.maps_key = None
        self.maps_service = 'Google'

        # retained for config compatibility with the reference's
        # multiprocessing threshold (Run.py:91); the TPU build vmaps per-day
        # kernel construction so this has no effect on execution.
        self.min_ndays = 6

        ### TPU-specific numerics (no reference equivalent)
        # half-width (cells) of the static per-minute kernel window; the
        # reference grows its window adaptively (ParasitoidModel.py:348).
        # None = auto-size from the run's Dparams (~4 sigma, the static
        # analog of the reference's 0.999-mass stopping rule); MCMC uses a
        # prior-coverage width instead (bayes/model.py).
        self.kernel_rad = None
        # half-width for the local-diffusion kernel window (None = auto)
        self.kernel_rad_local = None
        # Gauss-Legendre nodes per cell column for BVN cell integration
        self.quad_nodes = 16
        # fused Pallas day-accumulate kernel: None = auto (on for TPU),
        # True/False to force (CLI: use_pallas=True/False)
        self.use_pallas = None
        # run the forward model in float64 for numerical validation
        # (SURVEY.md section 7 step 3: "f64 flag for validation"); the
        # reference CPU path is f64 (CalcSol.py), its GPU path f32
        self.use_f64 = False
        # emulate the reference's cdf_eps=0.001 per-minute kernel
        # truncation (ParasitoidModel.py:329,348) — a parity tool (see
        # ops/daily_kernel.KernelConfig.ref_trunc), not for production
        self.ref_trunc = False
        ### Bayesian observation model (beyond-reference; VERDICT r3 item 6)
        # 'poisson' = the reference's thinned-Poisson likelihood
        # (Bayes_Run.py:344-433); 'negbin' adds a Gamma(2, 0.1)-prior
        # dispersion r (var = mu + mu^2/r); 'zip' adds a Beta(1, 3)-prior
        # zero-inflation probability.  The 100-draw PPC on the Kalbar NUTS
        # fit showed the Poisson model under-predicting the peak grid
        # count and field zero-inflation (runs/nuts_r3_ppc100.json);
        # compare variants with python -m parasitoids_tpu.bayes.loo.
        self.obs_model = 'poisson'

        self.default_chg()

    # ------------------------------------------------------------------
    # dataset presets (ref: Run.py:96-153)
    # ------------------------------------------------------------------
    def my_datasets(self):
        # pre-wind local-spread day in MAP fits (Bayes_MAP.py:200-205):
        # implied for kalbar (bayes/map_fit.default_use_sprd); generic
        # sites opt in via "sprd_factor": true in their site spec
        self.use_sprd_factor = False
        if self.dataset is None:
            self.site_name = 'data/carnarvonearl'
            self.start_time = '00:30'
            self.coord = None
            self.r_dur = None
            self.r_dist = None
            self.r_start = None
            self.r_number = None
        elif self.dataset == 'carnarvon':
            self.site_name = 'data/carnarvonearl'
            self.start_time = '00:30'
            self.coord = (-24.851614, 113.731267)
            self.r_dur = 5            # release duration, days
            self.r_dist = 'uniform'   # release emergence distribution
            self.r_start = 0.354      # 8:30am as fraction of day
            self.r_number = 40000
        elif self.dataset == 'kalbar':
            self.site_name = 'data/kalbar'
            self.start_time = '00:00'
            self.coord = (-27.947131, 152.584171)
            self.r_dur = 1
            self.r_dist = 'uniform'
            self.r_start = None       # wind recording began midnight post release
            self.r_number = 130000
        else:
            # generic site: release/run parameters come from the same
            # data/<name>site.json spec that supplies the observation
            # tables (io/site.py) — no reference equivalent (Run.py:96-153
            # supports exactly two hard-coded presets)
            from .io.site import load_site_spec
            spec = load_site_spec('data', self.dataset)
            if spec is not None:
                self.site_name = spec.get('site_name',
                                          'data/' + self.dataset)
                self.start_time = spec.get('start_time', '00:00')
                coord = spec.get('coord')
                self.coord = None if coord is None else tuple(coord)
                self.r_dur = int(spec.get('r_dur', 1))
                self.r_dist = spec.get('r_dist', 'uniform')
                r_start = spec.get('r_start')
                self.r_start = None if r_start is None else float(r_start)
                self.r_number = int(spec.get('r_number', 1))
                self.use_sprd_factor = bool(spec.get('sprd_factor', False))
            else:
                # the reference prints one line here and keeps the stale
                # previous preset's site/release parameters — with generic
                # sites in play (a typo'd name, or running outside the
                # directory holding data/) that silently simulates the
                # WRONG site under the requested label, so fail loudly
                raise ValueError(
                    'unknown dataset {0!r}: not a built-in preset '
                    '(kalbar/carnarvon) and no site spec at {1} '
                    '(cwd {2})'.format(
                        self.dataset,
                        os.path.join('data', self.dataset + 'site.json'),
                        os.getcwd()))

        if self.dataset is not None:
            stamp = time.strftime('%m%d-%H%M')
            tag = self.dataset if self.PROB_MODEL else self.dataset + '_pop'
            self.outfile = 'output/' + tag + stamp
        else:
            tag = '' if self.PROB_MODEL else 'poprun'
            self.outfile = 'output/' + tag + time.strftime('%m%d-%H%M')

    # ------------------------------------------------------------------
    # release emergence distribution (ref: Run.py:159-179)
    # ------------------------------------------------------------------
    def uniform(self, day):
        '''Uniform distribution over emergence days, 1 <= day <= r_dur.'''
        return 1. / self.r_dur

    def custom(self, day):
        # parity stub (ref Run.py:164-166 expects the user to edit the
        # source); pass explicit weights instead: r_dist=(w1,...,w_rdur)
        raise NotImplementedError(
            'custom release distribution not defined — pass explicit '
            'daily weights instead, e.g. r_dist="(0.2,0.5,0.3)" on the '
            'CLI or "r_dist": [0.2, 0.5, 0.3] in a site spec')

    def r_mthd(self):
        if isinstance(self.r_dist, (list, tuple)):
            w = [float(v) for v in self.r_dist]
            if len(w) != self.r_dur:
                raise ValueError(
                    'r_dist has {} weights but r_dur = {}'.format(
                        len(w), self.r_dur))
            if min(w) < 0 or sum(w) <= 0:
                raise ValueError('r_dist weights must be non-negative '
                                 'with a positive sum: {}'.format(w))
            total = sum(w)
            return lambda day: w[day - 1] / total
        if self.r_dist == 'uniform':
            return self.uniform
        elif self.r_dist == 'custom':
            return self.custom
        raise ValueError('unknown r_dist {!r}'.format(self.r_dist))

    # ------------------------------------------------------------------
    # layered parameter updates
    # ------------------------------------------------------------------
    def default_chg(self, path='config.txt'):
        '''Apply overrides from config.txt; create a template if absent
        (ref: Run.py:185-215).'''
        try:
            with open(path, 'r') as f:
                for line in f:
                    c = line.find('#')
                    if c >= 0:
                        line = line[:c]
                    key, eq, val = line.partition('=')
                    if eq:
                        self.chg_param(key.strip(), val.strip())
            # the reference re-runs my_datasets() here (Run.py:202), which
            # clobbers every preset-owned key a config.txt just set
            # (r_number, outfile, ...); chg_param already re-applies the
            # preset immediately when dataset/prob_model change, so the
            # trailing call is purely destructive — wart fixed, not copied
        except FileNotFoundError:
            try:
                with open(path, 'w') as f:
                    f.write('# local configuration file\n\n'
                            '# Accepts keyword parameter assignments of the '
                            'form <parameter> = <value>\n'
                            '# Any line starting with # will be ignored.\n\n'
                            '# To include satellite imagery, obtain a maps key '
                            "and assign it to 'maps_key' here.\n")
            except OSError:
                pass

    _FLAG_ACTIONS = {
        'no_output': ('OUTPUT', False), 'output': ('OUTPUT', True),
        'no_plot': ('PLOT', False), 'plot': ('PLOT', True),
        'no_cuda': ('CUDA', False), 'cuda': ('CUDA', True),
    }

    def cmd_line_chg(self, args):
        '''Apply CLI overrides: ``--flag`` options and ``key=value`` pairs
        (ref: Run.py:218-261).

        Flags are applied before key=value pairs regardless of their
        position on the command line: ``--pop``/``--kalbar`` re-apply the
        dataset preset, and in the reference's single in-order pass that
        silently clobbered any override given earlier on the same line
        (``r_number=5000 --pop`` ran with the preset's 130000).  Two-pass
        application makes the documented "preset -> CLI" precedence hold
        for every argument order.'''
        flags = [a for a in args if a.startswith('--')]
        pairs = [a for a in args if not a.startswith('--')]
        for argstr in flags:
            opt = argstr[2:].lower()
            if opt in self._FLAG_ACTIONS:
                name, value = self._FLAG_ACTIONS[opt]
                setattr(self, name, value)
            elif opt in ('pop', 'popmodel', 'pop_model'):
                self.PROB_MODEL = False
                self.my_datasets()
            elif opt in ('prob', 'probmodel', 'prob_model'):
                self.PROB_MODEL = True
                self.my_datasets()
            elif opt in ('carnarvon', 'kalbar'):
                self.dataset = opt
                self.my_datasets()
            else:
                raise ValueError('Unrecognized option {0}.'.format(argstr))
        for argstr in pairs:
            arg, _, val = argstr.partition('=')
            self.chg_param(arg, val)

    @staticmethod
    def _parse_bool(val):
        v = str(val).strip().lower()
        if v in ('true', '1', 'yes', 'on'):
            return True
        if v in ('false', '0', 'no', 'off'):
            return False
        # a fallthrough to bool(val) would turn 'no'/'off' into True —
        # mis-typed booleans must fail loudly like every other parameter
        raise ValueError('not a boolean: {0!r}'.format(val))

    @staticmethod
    def _parse_tuple(val, types):
        parts = val.strip(' ()').split(',')
        if len(parts) != len(types):
            raise ValueError('expected {} values'.format(len(types)))
        return tuple(t(p) for t, p in zip(types, parts))

    def chg_param(self, arg, val):
        '''Set one parameter from its string representation
        (ref: Run.py:263-352).'''
        f, i = float, int
        try:
            if arg.lower() == 'prob_model':
                self.PROB_MODEL = self._parse_bool(val)
                self.my_datasets()
            elif arg == 'outfile':
                self.outfile = val
            elif arg == 'dataset':
                self.dataset = val
                self.my_datasets()
            elif arg == 'site_name':
                self.site_name = val
            elif arg == 'start_time':
                self.start_time = val
            elif arg == 'coord':
                self.coord = self._parse_tuple(val, (f, f))
            elif arg == 'domain_info':
                self.domain_info = self._parse_tuple(val, (f, i))
            elif arg in ('interp_num', 'ndays', 'r_dur', 'n_periods',
                         'min_ndays', 'kernel_rad', 'kernel_rad_local',
                         'quad_nodes'):
                setattr(self, arg, i(val))
            elif arg == 'use_pallas':
                self.use_pallas = self._parse_bool(val)
            elif arg == 'use_f64':
                self.use_f64 = self._parse_bool(val)
            elif arg == 'ref_trunc':
                self.ref_trunc = self._parse_bool(val)
            elif arg == 'obs_model':
                if val not in ('poisson', 'negbin', 'zip'):
                    raise ValueError(
                        "obs_model must be 'poisson', 'negbin' or 'zip'; "
                        'got {!r}'.format(val))
                self.obs_model = val
            elif arg in ('sprd_factor', 'use_sprd_factor'):
                # restore/override after a preset change reset it (presets
                # re-apply my_datasets, which defaults this to False)
                self.use_sprd_factor = self._parse_bool(val)
            elif arg == 'r_start':
                self.r_start = f(val)
            elif arg == 'r_number':
                self.r_number = i(val)
            elif arg == 'r_dist':
                # 'uniform' / 'custom', or explicit daily weights
                # "(0.2,0.5,0.3)" (normalized at use in r_mthd)
                if '(' in val or ',' in val:
                    self.r_dist = tuple(
                        f(v) for v in val.strip(' ()').split(','))
                else:
                    self.r_dist = val
            elif arg == 'g_params':
                self.g_params = self._parse_tuple(val, (f, f))
            elif arg == 'f_params':
                self.f_params = self._parse_tuple(val, (f, f, f, f))
            elif arg in ('Dparams', 'Dlparams'):
                setattr(self, arg, self._parse_tuple(val, (f, f, f)))
            elif arg in ('lam', 'mu_r'):
                setattr(self, arg, f(val))
            elif arg == 'maps_key':
                self.maps_key = val
            elif arg == 'maps_service':
                self.maps_service = val
            elif arg == 'output':
                self.OUTPUT = self._parse_bool(val)
            elif arg == 'plot':
                self.PLOT = self._parse_bool(val)
            elif arg == 'cuda':
                self.CUDA = self._parse_bool(val)
            else:
                raise LookupError('Unrecognized parameter {0}.'.format(arg))
        except LookupError:
            print('Could not parse {0}.\n '.format(arg))
            raise
        except ValueError:
            print('Could not parse {0}.'.format(arg) +
                  ' Try enclosing this argument in quotations.\n ')
            raise

    def file_read_chg(self, filename):
        '''Load parameters from a saved-run JSON sidecar
        (ref: Run.py:355-368).  Unknown keys are set verbatim so sidecars
        written by the reference load cleanly.'''
        if not filename.rstrip().endswith('.json'):
            filename = filename.rstrip() + '.json'
        with open(filename) as fobj:
            param_dict = json.load(fobj)
        for key, value in param_dict.items():
            if isinstance(value, list):
                value = tuple(value)
            setattr(self, key, value)

    def save_json(self, filename=None):
        '''Write the parameter sidecar, stripping the maps key
        (ref: Run.py:512-516).'''
        filename = filename or self.outfile + '.json'
        d = os.path.dirname(filename)
        if d:
            os.makedirs(d, exist_ok=True)
        param_dict = dict(self.__dict__)
        param_dict.pop('maps_key', None)
        with open(filename, 'w') as fobj:
            json.dump(param_dict, fobj)

    # ------------------------------------------------------------------
    # packers (ref: Run.py:374-384)
    # ------------------------------------------------------------------
    def get_model_params(self):
        '''Params in the order of the daily-kernel builder signature,
        minus day & wind data.'''
        hparams = (self.lam, *self.g_params, *self.f_params)
        return (hparams, self.Dparams, self.Dlparams, self.mu_r,
                self.n_periods, *self.domain_info)

    def get_wind_params(self):
        return (self.site_name, self.interp_num, self.start_time)
