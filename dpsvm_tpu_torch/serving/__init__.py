"""dpsvm_tpu_torch.serving — the v2 serving engine (counterpart of
dpsvm_tpu/serving).

* :mod:`registry`    — named, versioned models with atomic hot swap: the
  incoming version is validated, staged and warmed before the name
  flips; a corrupted file never disturbs the live version; a JSON
  journal that either package replays.
* :mod:`scheduler`   — deadline-aware continuous batching: EDF batch
  forming per union group, expired requests shed with a verdict.
* :mod:`engine_core` — union groups on the device (one kernel product
  answers every model sharing a union, mesh-sharded with
  ``num_devices > 1``) and the double-buffered async dispatcher.
* :mod:`dispatch`    — :class:`ServingEngine`, submit / pump / drain
  over the three, with always-on instruments and /metrics.
* :mod:`wire`, :mod:`server`, :mod:`client` — the network front door:
  the JAX package's frames byte for byte, :class:`ServeServer`
  (admission, connection bounds, protocol-error containment, drain)
  and :class:`ServeClient` (retries only what cannot duplicate work).
* :mod:`replicas`    — :class:`ReplicaFleet`, N engines behind one
  front door over one shared journal.
"""

from dpsvm_tpu_torch.serving.client import ServeClient
from dpsvm_tpu_torch.serving.dispatch import ServeResult, ServingEngine
from dpsvm_tpu_torch.serving.registry import (LoadedModel, ModelLoadError,
                                              ModelRegistry, RegistryJournal,
                                              load_model_file)
from dpsvm_tpu_torch.serving.replicas import ReplicaFleet
from dpsvm_tpu_torch.serving.scheduler import Request, Scheduler
from dpsvm_tpu_torch.serving.server import ServeServer

__all__ = [
    "ServingEngine", "ServeResult", "ModelRegistry", "RegistryJournal",
    "LoadedModel", "ModelLoadError", "load_model_file", "Scheduler",
    "Request", "ServeServer", "ServeClient", "ReplicaFleet",
]
