"""The paper's own workload: evolving social graphs + truss maintenance.

Dataset scales mirror Table 2 (Epinions/Enron/Slashdot) structurally;
CPU-sized synthetic power-law replicas are used for runnable benchmarks and
the full scales drive the distributed dry-run of the truss engine.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class TrussWorkload:
    name: str
    n_nodes: int
    n_edges: int
    m_per_node: int
    query_ks: tuple[int, ...]
    n_updates: tuple[int, ...] = (1000, 3000, 5000, 8000)


# Table 2 analogues (same |V|/|E| ratios; power-law + triangle closure)
EPINIONS = TrussWorkload("epinions-like", 75_879, 508_837, 7, (33, 25, 20, 15))
ENRON = TrussWorkload("enron-like", 36_692, 183_831, 5, (22, 18, 14, 10))
SLASHDOT = TrussWorkload("slashdot-like", 77_360, 905_468, 12, (34, 30, 25, 15))

# CPU-benchable replicas (same generator, reduced scale; used by benchmarks/)
EPINIONS_SMALL = TrussWorkload("epinions-small", 3000, 20_000, 7, (6, 5, 4))
ENRON_SMALL = TrussWorkload("enron-small", 1500, 7_500, 5, (5, 4, 3))
SLASHDOT_SMALL = TrussWorkload("slashdot-small", 3000, 34_000, 12, (7, 5, 4))

WORKLOADS = {w.name: w for w in
             [EPINIONS, ENRON, SLASHDOT, EPINIONS_SMALL, ENRON_SMALL, SLASHDOT_SMALL]}
