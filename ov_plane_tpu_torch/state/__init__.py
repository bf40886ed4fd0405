"""Filter state: static covariance layout, batched VioState, IMU propagator."""
