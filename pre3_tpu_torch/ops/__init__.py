"""Device ops: closed-form 3x3 SVD, descriptor matching, RANSAC scoring."""
