"""Bayesian layer of the port: priors, bijections, the log posterior
(``model.BayesSetup``), MAP and the Laplace approximation (``map_fit``),
adaptive Metropolis (``sampler``), its trace store (``store``), NUTS
(``nuts``), parallel tempering (``tempering``), adaptive tempered SMC
(``smc``), ADVI (``vi``), diagnostics, the MCMC command line (``run``),
the analysis of a saved trace: predictive checks (``predictive``), WAIC
and PSIS-LOO (``loo``, with ``vi.psis``), spread maps (``spread``),
power-scaling sensitivity (``sensitivity``), identifiability
(``identify``) and the one-command report (``summary``), and the
self-validation of the stack: exact leave-one-group-out cross-validation
(``cv``) and simulation-based calibration (``sbc``)."""

from .priors import (ModelParams, ObsParams, log_prior_model,  # noqa: F401
                     log_prior_obs, MODEL_PARAM_NAMES, OBS_PARAM_NAMES,
                     initial_model_params, initial_obs_params, STEP_SCALES)
