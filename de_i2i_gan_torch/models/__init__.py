"""DefectGAN generator and AdaIN style extractor."""
