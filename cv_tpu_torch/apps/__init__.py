"""Host-side applications: the vslam-sandbox app, kpdraw, the tutorial
programs and the synthetic star-field sequence renderer."""
