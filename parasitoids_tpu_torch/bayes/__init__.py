"""Bayesian layer of the port: priors, bijections, the log posterior
(``model.BayesSetup``), MAP (``map_fit``), adaptive Metropolis
(``sampler``), its trace store (``store``), diagnostics and the MCMC
command line (``run``)."""

from .priors import (ModelParams, ObsParams, log_prior_model,  # noqa: F401
                     log_prior_obs, MODEL_PARAM_NAMES, OBS_PARAM_NAMES,
                     initial_model_params, initial_obs_params, STEP_SCALES)
