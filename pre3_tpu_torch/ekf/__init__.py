"""EKF-SLAM: masked state, prediction, measurement, update, 1-point
RANSAC, map management, and the step with its sequence loop."""
