"""The calibrated performance model of the paper's fabrics (the JAX
package's ``repro.perfmodel``, framework-free, copied): alpha-beta
models of Table 1's interconnects, the coherence-mode latencies of
Fig 11, ``protocol_time`` over the port's ``ProtocolStats``, the
discrete-event ``Engine`` and the Fig-10 program skeletons (``apps``)."""
from repro_torch.perfmodel.interconnects import (CXL_SHM, CXL_SHM_NOFLUSH,
                                           ETHERNET_TCP, INFINIBAND_CX6,
                                           INTERCONNECTS, MAIN_MEMORY,
                                           MELLANOX_TCP, ROCE_CX3, ROCE_CX6,
                                           Interconnect, coherence_latency)
from repro_torch.perfmodel.simulator import Engine, Proc
