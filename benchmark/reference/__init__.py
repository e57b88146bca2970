"""The benchmark's plain reference of one env step and of one PPO update.

It imports nothing of the program. ``numeric``, ``quaternion``, ``spec``,
``builders``, ``skeleton``, ``convert``, ``clip`` and ``field_physics`` are
frozen copies of ``pbrl_tpu_torch``'s modules of the same names
(``maths/``, ``model/``, ``mocap/``, ``ops/``) taken at commit 313d0e0,
with their imports renamed, the native clip reader and the DiffMimic path
dropped (``convert`` reads the DeepMimic file with ``json``) and the
kernel-table packing dropped from ``field_physics``. ``env`` and
``learner`` are written here: the step's targets, physics (the plain
field program, 8 substeps then FK), quarantine, observation, reward and
termination; and the learner's networks, observation statistics, GAE,
clipped-surrogate loss and optax-style Adam.
"""
