"""Image front-end of the port: FAST corners, binary descriptors, the
plane-homography patch warp, NCC matching (kernel K7) and the SLAM frame
from pixels (frontend.step_image, run_images)."""
