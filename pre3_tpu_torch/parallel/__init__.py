"""Multi-device: process meshes, sharded RANSAC and BA, the dry run."""
