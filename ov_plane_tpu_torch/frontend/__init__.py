"""Vision frontend of the port: image preprocessing, pyramidal KLT, FAST,
gyro RANSAC, the host plane detector and the fused frontend + filter step."""
