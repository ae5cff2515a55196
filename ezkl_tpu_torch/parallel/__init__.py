"""Multi-device sharding of the prover's MSM and NTT (port of
`ezkl_tpu/parallel/`): one process drives a mesh, an ordered tuple of
torch devices. The MSM is data-parallel over the point axis with a fold of
the partials; the NTT is the four-step (Bailey) decomposition with one
all_to_all between the two local NTT phases."""

from .sharded import make_mesh, msm_sharded, ntt_sharded  # noqa: F401
