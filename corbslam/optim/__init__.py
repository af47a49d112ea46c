"""Nonlinear least-squares optimization: the batched replacement of g2o +
Optimizer.cc (ref: corbslam_client/Thirdparty/g2o, src/Optimizer.cc).

Batched Levenberg-Marquardt with analytic Jacobians:
  pose_opt     motion-only pose LM (PoseOptimization)
  ba           windowed/global BA with Schur-complement point marginalization
               (LocalBundleAdjustment / GlobalBundleAdjustemnt)
  pose_graph   Sim3 essential-graph optimization (OptimizeEssentialGraph)
  sim3_opt     relative Sim3 refinement (OptimizeSim3)
"""
