"""Camera models, one module a model, named by a configuration's
`camera.model`: how the generator renders the raw image, how the program
is given the camera, and the plain reference of the model."""
