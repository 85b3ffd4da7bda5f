"""Default SDE (diffusion) settings, as a plain dict.

Counterpart of ``equivariant_nn_zoo_tpu/models/sde_config.py``: the same
fields (training, sampling, the VP-SDE's beta range and number of scales,
the EMA rate, the optimizer, the seed) as nested dicts.
"""


def get_config():
    return dict(
        training=dict(continuous=True, snapshot_sampling=True,
                      n_iters=1000000, reduce_mean=True,
                      likelihood_weighting=False),
        sampling=dict(method="pc", predictor="euler_maruyama",
                      corrector="langevin", snr=0.16, n_steps_each=1,
                      noise_removal=True),
        model=dict(beta_min=0.1, beta_max=20.0, num_scales=1000,
                   ema_rate=0.9999),
        optim=dict(optimizer="Adam", lr=2e-4, beta1=0.9, eps=1e-8,
                   weight_decay=0.0),
        seed=42,
    )
