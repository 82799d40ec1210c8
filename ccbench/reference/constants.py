# FROZEN COPY of ``continuous_clustering_tpu_torch/constants.py`` at commit cce7c49ab9acd93ca72165a17ff47a74717926ce.
#
# Part of the benchmark's yardstick: later changes to the program do not
# edit this file, so the benchmark measures every commit with the same
# code.  Only imports were changed, so that nothing here imports the
# program or the JAX package.  The original's docstring follows.

"""Shared label constants.

The reference encodes ground-point labels as entries of a 147-color debug enum
(``clustering/continuous_clustering.hpp:15-22`` aliases GP_* onto colors).  We
separate the two concerns: compact semantic labels (used on device) and debug
labels (used only for visualization / oracle-exact backtracking rules).
"""

# Semantic ground point labels (device-side uint8).  Values equal the
# reference's color-enum aliases (clustering/continuous_clustering.hpp:15-22
# onto general.hpp:208-357) so the published ``ground_point_label`` and
# ``debug_ground_point_label`` fields are value-identical for drop-in users.
GP_UNKNOWN = 143      # WHITE
GP_GROUND = 54        # GREEN
GP_OBSTACLE = 119     # RED
GP_EGO_VEHICLE = 85   # MAGENTA
GP_FOG = 71           # LIGHTGRAY

# Debug labels. The *identities* matter because the reference's
# obstacle-backtracking and last-ground-point rules branch on them
# (src/clustering/continuous_clustering.cpp:519,542,548); the values mirror
# the reference's QColor-aligned enum.
DBG_WHITE = 143       # unknown
DBG_GRAY = 53         # first ring as ground
DBG_GREEN = 54        # certain ground (flat wrt prev, no obstacle yet)
DBG_YELLOWGREEN = 146  # ground (flat wrt prev + last ground, after obstacle)
DBG_YELLOW = 145      # ground because close to last certain ground
DBG_ORANGE = 105      # first point is obstacle
DBG_RED = 119         # obstacle
DBG_DARKRED = 32      # retroactively relabeled obstacle
DBG_VIOLET = 141      # ego vehicle
DBG_LIGHTGRAY = 71    # fog
DBG_BURLYWOOD = 12    # terrain ground (stubbed, like the reference)

# Sentinel for "no cluster"
NO_CLUSTER = 0
