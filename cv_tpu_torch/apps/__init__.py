"""Host-side applications: the vslam-sandbox app and the synthetic
star-field sequence renderer."""
