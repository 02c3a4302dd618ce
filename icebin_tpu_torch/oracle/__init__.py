"""The f64 numpy clip, the referee of the clip kernels."""
