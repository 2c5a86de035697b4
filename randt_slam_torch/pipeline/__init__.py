"""Front-end step and the offline odometry loop."""
