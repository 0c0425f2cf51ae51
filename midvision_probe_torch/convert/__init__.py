"""Weight converters into the PyTorch port's layouts."""
