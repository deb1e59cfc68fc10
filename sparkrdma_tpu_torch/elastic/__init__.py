"""Elastic cluster layer: speculative reduce cloning
(:mod:`~sparkrdma_tpu_torch.elastic.speculation`), the first finisher
wins; ``engine/cluster.py`` runs every reduce fan-out through it.

The JAX package's ``elastic/`` also holds map-output replication
(``replication.py``) and the detachable shuffle-service daemon
(``service.py``); both come with ROADMAP item M8b, so this package
exports nothing from them (the port's manager raises for
``tpu.shuffle.elastic.replicas`` > 0).
"""
