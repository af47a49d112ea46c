"""corbslam — a collaborative visual SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of CORB-SLAM
(reference: lifunudt/CORB-SLAM): multi-robot ORB feature SLAM with a central
map-fusion server. The compute path (feature extraction, descriptor matching,
bundle adjustment, place recognition, geometric solvers) runs as batched XLA
programs over fixed-capacity structure-of-arrays map
state; the collaboration layer shards per-client sub-maps over a
`jax.sharding.Mesh` and fuses them with collective reductions.

Layer map (mirrors SURVEY.md §1 of the reference analysis):
  geometry/   SE3/Sim3 Lie groups, pinhole cameras, triangulation
  ops/        XLA compute ops (FAST, BRIEF, Hamming, stereo, pyramid)
  matching/   batched descriptor search policies (ref: ORBmatcher.cc)
  optim/      Levenberg-Marquardt pose/local/global BA + Sim3 pose graph (ref: g2o+Optimizer.cc)
  solvers/    EPnP RANSAC, Horn Sim3 RANSAC, two-view initializer
  place/      bag-of-binary-words vocabulary + keyframe database (ref: DBoW2)
  mapstate/   fixed-capacity SoA map pytree: keyframes, map points, covisibility
  frontend/   frame construction + tracking state machine (ref: Tracking.cc)
  mapping/    local mapping + loop closing (ref: LocalMapping.cc, LoopClosing.cc)
  collab/     client cache / delta sync / server map fusion (ref: Cache.cc, MapFusion.cpp)
  parallel/   meshes, shardings, distributed Schur-complement BA
  models/     assembled front-end pipelines (stereo / RGB-D / monocular)
  io/         dataset drivers, synthetic scene generation, trajectory export
"""

__version__ = "0.1.0"
