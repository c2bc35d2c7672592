"""The camera branch's modules (port of dfu3d_tpu/models/image): the Swin
backbone, the LSS FPN neck, the depth-LSS view transform, CaDDN's DDNs and
frustum sampling."""
