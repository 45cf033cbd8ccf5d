"""Multi-process SPMD realisation of the paper's method 2c (counterpart of
``repro.distributed``): the process group and its launcher (``group``),
the shard-frontier routing tables and the LM zoo's sharding specs
(``sharding``), the activation constraints the dry run records (``ctx``),
locality-aware placement (``placement``), the spike-parcel transports
(``exchange``) and the shard-local FAP round with its run loop
(``fap_spmd``)."""
from repro_torch.distributed.exchange import (ExchangeSpec,  # noqa: F401
                                              Transport, get_transport)
from repro_torch.distributed.group import Group, launch  # noqa: F401
from repro_torch.distributed.placement import (Placement,  # noqa: F401
                                               compute_placement,
                                               place_network,
                                               unpermute_result)
