"""Models of the port: the conv models (ENet, ESPNet, DCGAN, the U-Net
decoder and denoiser, the Whisper frontend) and the dense LM path (config,
layers, attention, transformer)."""
