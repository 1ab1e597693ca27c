"""Visual odometry: rigid fits, batched RANSAC, dead reckoning."""
