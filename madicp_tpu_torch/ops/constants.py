"""Compile-time constants of the MAD-ICP algorithm.

Parity with reference ``mad_icp/src/tools/constants.h:31-35``.
"""

# Number of azimuth bins used by motion-based deskewing
# (reference constants.h:31).
CHUNKS = 1024

# Length of the pose window used by the velocity estimator
# (reference constants.h:32).
SMOOTHING_T = 10

# Robust-kernel threshold of the velocity estimator
# (reference constants.h:33).
E_THRESHOLD_VEL = 0.3162

# Number of full re-association Gauss-Newton rounds per scan
# (reference constants.h:34).
MAX_ICP_ITS = 15

# Capacity of the keyframe-candidate window (reference constants.h:35).
FRAME_WINDOW = 10
