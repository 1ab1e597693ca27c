"""Feature frontend: FAST corners, patch descriptors, depth lift."""
