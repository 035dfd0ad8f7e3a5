"""FL-DP³S core: data profiling, eq.-(14) similarity kernel, k-DPP selection.

Re-exports what ``repro.core`` exports, apart from the two-stage funnel
(``CandidateSet``, ``funnel_candidates``, ``funnel_scores``), which waits
for the engine's funnel features.
"""

from repro_torch.core.dpp import (
    KDPPSamplerState,
    elementary_symmetric,
    greedy_map_kdpp,
    kdpp_log_prob,
    kdpp_sampler_state,
    log_det_subset,
    sample_kdpp,
    sample_kdpp_from_eigh,
)
from repro_torch.core.metrics import cohort_label_distribution, gemd, label_distribution
from repro_torch.core.profiles import (
    fc1_profile,
    gradient_profile,
    profile_all_clients,
    representative_gradient_profile,
)
from repro_torch.core.selection import (
    ClusterSelection,
    DPPSelection,
    FedSAESelection,
    PowerOfChoiceSelection,
    RoundState,
    SelectionStrategy,
    UniformSelection,
    make_strategy,
)
from repro_torch.core.similarity import (
    candidate_kernel,
    dpp_kernel,
    kernel_from_profiles,
    pairwise_dists,
    pairwise_sq_dists,
    similarity_matrix,
)
